"""SAME-TPU: accelerator-native spatial alignment of multimodal expression.

A ground-up JAX/XLA rebuild of SAME (rohitsinghlab/SAME): cells are
matched between serial tissue sections / modalities by a capacity-constrained
assignment over a kNN candidate graph with Delaunay triangle-orientation
("space-tearing") penalties. The reference's Gurobi MIP with lazy callback
cuts becomes an epsilon-scaling auction solver plus a vectorized
orientation-cut separation loop, running as fixed-shape XLA computations on
the GPU; sliding windows shard across a device mesh.

Public API mirrors the reference's ``src/__init__.py`` export list so the
paper notebooks and scripts run unmodified, plus the evaluation and
robustness utilities they import from submodules.
"""

from .candidates import (
    find_knn_with_cell_type_priority,
    find_knn_within_radius,
    preprocess_data,
)
from .core import finalize_window, prepare_window, run_same, solve_prepared
from .io import load_matching_results
from .eval import (
    check_alignment,
    check_triangle_violations,
    print_violation_report,
    topk_type_match,
    verify_spatial_preservation,
)
from .geometry import calculate_signed_area, signed_area_terms
from .metacell import MetaCell, greedy_triangle_collapse, unpack_metacell_matches
from .robustness import add_dirichlet_mixture_noise
from .synthetic import create_full_benchmark
from .utils.params import init_gurobi_params, init_optim_params, init_solver_params
from .windows import (
    get_unprocessed_windows,
    merge_window_matches_unique_ref,
    sliding_window_matching,
    subset_data,
)

__version__ = "0.1.0"

__all__ = [
    # Reference public API (src/__init__.py:56-65)
    "init_gurobi_params",
    "init_optim_params",
    "sliding_window_matching",
    "run_same",
    "merge_window_matches_unique_ref",
    "MetaCell",
    "greedy_triangle_collapse",
    "unpack_metacell_matches",
    # Solver-parameter alias + submodule utilities the notebooks use
    "init_solver_params",
    "find_knn_within_radius",
    "find_knn_with_cell_type_priority",
    "check_alignment",
    "check_triangle_violations",
    "topk_type_match",
    "verify_spatial_preservation",
    "print_violation_report",
    "calculate_signed_area",
    "signed_area_terms",
    "add_dirichlet_mixture_noise",
    "create_full_benchmark",
    "get_unprocessed_windows",
    "subset_data",
    "preprocess_data",
    "load_matching_results",
    # Staged pipeline (multi-chip orchestration hooks)
    "prepare_window",
    "solve_prepared",
    "finalize_window",
]
