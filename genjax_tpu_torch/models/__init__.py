"""Models."""

from .regression import RegressionModel, hierarchical_regression, linear_regression

__all__ = ["RegressionModel", "hierarchical_regression", "linear_regression"]
