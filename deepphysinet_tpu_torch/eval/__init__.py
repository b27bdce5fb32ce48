"""Evaluation sweeps over held-out windows: full-grid RMSE and PDE residuals."""
