"""SoftAdapt loss-weight estimation (the port's copy of
``m2mixer_tpu/modules/softadapt.py``, plain numpy).

The ``LossWeightedSoftAdapt`` variant (Heydari et al., "SoftAdapt:
Techniques for Adaptive Loss Weighting of Neural Networks with Multi-Part
Loss Functions", 2019): per-component loss slopes are estimated with
backward finite differences of the requested accuracy order (Fornberg
coefficients), and the weights are the loss-magnitude-scaled softmax of
``beta *`` the normalized slopes. ``MultiLossTask`` refits them from the
per-branch validation losses every ``update_loss_weights_per_epoch`` epochs.
"""

from __future__ import annotations

import numpy as np

__all__ = ["LossWeightedSoftAdapt", "finite_difference_coefficients"]


def finite_difference_coefficients(order: int, accuracy: int) -> np.ndarray:
    """Fornberg weights for the d^order/dx^order at the RIGHT endpoint of a
    uniform unit grid of ``accuracy + order`` points (backward stencil)."""
    n_points = accuracy + order
    grid = np.arange(-(n_points - 1), 1, dtype=np.float64)  # ..., -2, -1, 0
    x0 = 0.0
    m = order
    # Fornberg (1988) recursive algorithm
    n = len(grid)
    delta = np.zeros((m + 1, n, n))
    delta[0, 0, 0] = 1.0
    c1 = 1.0
    for nn in range(1, n):
        c2 = 1.0
        for v in range(nn):
            c3 = grid[nn] - grid[v]
            c2 *= c3
            for mm in range(min(nn, m) + 1):
                delta[mm, nn, v] = (
                    (grid[nn] - x0) * delta[mm, nn - 1, v] - mm * delta[mm - 1, nn - 1, v]
                ) / c3
        for mm in range(min(nn, m) + 1):
            delta[mm, nn, nn] = (c1 / c2) * (
                mm * delta[mm - 1, nn - 1, nn - 1] - (grid[nn - 1] - x0) * delta[mm, nn - 1, nn - 1]
            )
        c1 = c2
    return delta[m, n - 1, :]


class LossWeightedSoftAdapt:
    """``w_i = mean(f_i) * exp(beta * s_hat_i) / sum_j mean(f_j) * exp(beta * s_hat_j)``
    where ``s_i`` is the finite-difference slope of component ``i``'s loss
    history and ``s_hat`` is ``s`` normalized by its max magnitude."""

    def __init__(self, beta: float = -0.1, accuracy_order: int = 5, epsilon: float = 1e-8):
        self.beta = beta
        self.accuracy_order = accuracy_order
        self.epsilon = epsilon

    def _slope(self, history: np.ndarray) -> float:
        k = self.accuracy_order
        if len(history) < k + 1:
            k = max(1, len(history) - 1)
        coeffs = finite_difference_coefficients(order=1, accuracy=k)
        window = np.asarray(history[-(k + 1):], dtype=np.float64)
        return float(np.dot(coeffs, window))

    def get_component_weights(self, *loss_histories: np.ndarray, verbose: bool = False) -> np.ndarray:
        slopes = np.array([self._slope(np.asarray(h, np.float64)) for h in loss_histories])
        avg_losses = np.array([float(np.mean(h)) for h in loss_histories])
        denom = np.max(np.abs(slopes)) + self.epsilon
        s_hat = slopes / denom
        # numerically stable softmax
        z = self.beta * s_hat
        z = z - z.max()
        expz = np.exp(z)
        weights = avg_losses * expz
        weights = weights / (weights.sum() + self.epsilon)
        if verbose:
            print(f"[softadapt] slopes={slopes} weights={weights}")
        return weights
