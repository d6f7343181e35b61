"""The paper's core modules: forecasting, the safeguard and the shaper."""
