"""Generic linear state-space Kalman filter.

NumPy port of the reference ``LinearSSKalmanFilter``
(``utils/kalman_filter.cpp:8-114``): multi-step covariance extrapolation for
irregular detection intervals, then a single innovation update.
"""

from typing import Optional

import numpy as np


class LinearSSKalmanFilter:
    def __init__(self, num_states: int, num_inputs: int):
        self.num_states = num_states
        self.num_inputs = num_inputs
        self.state = np.zeros((num_states, 1))
        self.A = np.zeros((num_states, num_states))
        self.B = np.zeros((num_states, num_inputs))
        self.Q = np.zeros((num_states, num_states))
        self.H = np.zeros((num_states, num_states))
        self.R = np.zeros((num_states, num_states))
        self.P = np.eye(num_states)
        self.system_initialized = False
        self.state_initialized = False

    def setup(self, A, B, Q, H, R) -> bool:
        shapes_ok = (
            np.shape(A) == self.A.shape
            and np.shape(B) == self.B.shape
            and np.shape(Q) == self.Q.shape
            and np.shape(H) == self.H.shape
            and np.shape(R) == self.R.shape
        )
        if not shapes_ok:
            return False
        self.A = np.asarray(A, dtype=np.float64)
        self.B = np.asarray(B, dtype=np.float64)
        self.Q = np.asarray(Q, dtype=np.float64)
        self.H = np.asarray(H, dtype=np.float64)
        self.R = np.asarray(R, dtype=np.float64)
        self.system_initialized = True
        return True

    def set_initial_state(self, initial_state) -> None:
        initial_state = np.asarray(initial_state, dtype=np.float64).reshape(-1, 1)
        if initial_state.shape[0] != self.num_states:
            raise ValueError(
                f"Initial state must have {self.num_states} entries"
            )
        self.state = initial_state
        self.state_initialized = True

    def estimate(self, measurements, number_steps: int = 1, inputs=None):
        """Predict ``number_steps`` then update with ``measurements``
        (``kalman_filter.cpp:61-88``). Returns False (no state change)
        before setup/initialization — S would be singular."""
        if not (self.system_initialized and self.state_initialized):
            return False
        if inputs is None:
            inputs = np.zeros((self.num_inputs, 1))
        measurements = np.asarray(measurements, dtype=np.float64).reshape(-1, 1)
        b_inputs = self.B @ np.asarray(inputs).reshape(self.num_inputs, 1)
        predicted = self.state
        for _ in range(number_steps):
            predicted = self.A @ predicted + b_inputs
            self.P = self.A @ self.P @ self.A.T + self.Q
        S = self.R + self.H @ self.P @ self.H.T
        K = self.P @ self.H.T @ np.linalg.inv(S)
        self.state = predicted + K @ (measurements - self.H @ predicted)
        self.P = (np.eye(self.num_states) - K @ self.H) @ self.P
        return True

    def get_state(self) -> Optional[np.ndarray]:
        if self.state_initialized and self.system_initialized:
            return self.state.copy()
        return None

    def get_state_element(self, index: int) -> float:
        if self.state_initialized:
            return float(self.state[index, 0])
        return 0.0
