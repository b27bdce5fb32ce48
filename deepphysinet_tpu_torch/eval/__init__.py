"""Evaluation sweeps over held-out windows: full-grid RMSE, PDE residuals and the off-lattice
score of a synthetic tree."""

from deepphysinet_tpu_torch.eval.offlattice import evaluate_offlattice
from deepphysinet_tpu_torch.eval.residuals import evaluate_residuals, residual_field_maps
from deepphysinet_tpu_torch.eval.rmse import evaluate_rmse, evaluate_rmse_fullgrid

__all__ = [
    "evaluate_rmse",
    "evaluate_rmse_fullgrid",
    "evaluate_residuals",
    "residual_field_maps",
    "evaluate_offlattice",
]
