"""RDF-ℏ core in PyTorch: the engine of ``repro.core``, module for module."""
from .graph import RDFGraph, IDMap, RESOURCE, LITERAL, REL, ATTR, csr_patch
from .ni_index import NIIndex, NIEntry, build_ni_index, \
    vertex_cover_2approx, khop_rows, patch_entry
from .dataset import (Dataset, ENGINE_VARIANTS, content_digest,
                      interval_footprint_hit)
from .query import QueryTemplate, QueryEdge, ConnectionEdge, brute_force_match
from .signature import build_requirements, check_template
from .decompose import DTree, decompose, join_order
from .matching import Table, CandidateTable, SortedRun, JoinTelemetry, \
    join_tables, cross_join, edge_pairs, graph_edges, \
    dtree_candidates, CapacityOverflow, resolve_join_impl, filter_rows, \
    injective_filter, dedup_project, empty_table
from .connectivity import (connectivity_mask, connectivity_mask_vectorized,
    ragged_reach, reach_sets,
    enumerate_shortest_paths,
    instantiate_connections, ReachCache, ReachJoinInfo, reach_pairs,
    connected_pair_table, reach_join, reach_filter,
    distinct_column_values, REACH_ID_COL)
from .stats import DatasetStats, compute_stats, predicate_selectivity, \
    literal_selectivity, coherence, relationship_specialty, \
    literal_diversity, connection_selectivity, expected_reach, \
    endpoint_reach, node_degrees, coherence_terms, coherence_from_terms, \
    specialty_terms, specialty_from_terms
from .planner import Thresholds, CostModel, PlanDecision, decide, \
    neighborhood_selectivity, tune_thresholds, JoinEstimator, \
    ReplayEstimator, CapEstimate, JoinPlan, PlannedStep, plan_table_joins, \
    simulate_join_order, ConnectionPlan, plan_connections, ConnFeatures, \
    connection_edge_cost, choose_connection_impl
from .engine import Engine, EngineConfig, MatchResult, PreparedQuery, \
    QueryStats, make_engine
from .distributed import shard_check, gather_candidates
